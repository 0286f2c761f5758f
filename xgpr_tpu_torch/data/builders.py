"""Validated dataset constructors.

Copied unchanged from xgpr_tpu/data/builders.py (pure numpy).  Parity
with the reference xGPR's data_handling/dataset_builder.py:
NaN / dtype / shape-consistency checks, sequence-length validation
(:337-373), streaming Welford-style mean/std over files (:408-437) and npy
header peeking so file shapes are checked without loading (:440-449).
"""
import numpy as np

from .dataset import OnlineDataset, OfflineDataset


def build_regression_dataset(xdata, ydata, sequence_lengths=None,
                             chunk_size=2000, normalize_y=True,
                             skip_safety_checks=False):
    """Build an in-memory or file-backed regression dataset."""
    if isinstance(xdata, list) and isinstance(ydata, list):
        return build_offline_np_dataset(xdata, ydata, sequence_lengths,
                                        chunk_size, normalize_y,
                                        task_type="regression",
                                        skip_safety_checks=skip_safety_checks)
    if isinstance(xdata, np.ndarray) and isinstance(ydata, np.ndarray):
        return _build_online_dataset(xdata, ydata, sequence_lengths,
                                     chunk_size, normalize_y,
                                     task_type="regression")
    raise RuntimeError("Pass either in-memory numpy arrays or lists of "
                       ".npy file paths for x and y.")


def build_classification_dataset(xdata, ydata, sequence_lengths=None,
                                 chunk_size=2000, skip_safety_checks=False):
    """Build an in-memory or file-backed classification dataset."""
    if isinstance(xdata, list) and isinstance(ydata, list):
        return build_offline_np_dataset(xdata, ydata, sequence_lengths,
                                        chunk_size, normalize_y=False,
                                        task_type="classification",
                                        skip_safety_checks=skip_safety_checks)
    if isinstance(xdata, np.ndarray) and isinstance(ydata, np.ndarray):
        return _build_online_dataset(xdata, ydata, sequence_lengths,
                                     chunk_size, normalize_y=False,
                                     task_type="classification")
    raise RuntimeError("Pass either in-memory numpy arrays or lists of "
                       ".npy file paths for x and y.")


def _check_basic_array(xdata, ydata):
    if not isinstance(xdata, np.ndarray) or not isinstance(ydata, np.ndarray):
        raise RuntimeError("In-memory datasets take numpy arrays for both x and y.")
    if xdata.ndim not in (2, 3):
        raise RuntimeError("X must be a 2d or 3d numpy array.")
    if ydata.ndim != 1:
        raise RuntimeError("y must be one-dimensional.")
    if xdata.shape[0] != ydata.shape[0]:
        raise RuntimeError("X and y must have the same number of "
                           "datapoints.")
    if xdata.shape[0] == 0:
        raise RuntimeError("Empty arrays supplied.")
    if not np.all(np.isfinite(xdata)):
        raise RuntimeError("One or more elements in X is inf or NaN.")
    if np.issubdtype(ydata.dtype, np.floating) and \
            not np.all(np.isfinite(ydata)):
        raise RuntimeError("One or more elements in y is inf or NaN.")
    if np.max(np.abs(xdata)) > 1e15:
        raise RuntimeError("Values > 1e15 in the input are not allowed.")


def _check_sequence_lengths(seqlength, xdata, ydata):
    """Sequence-length contract (dataset_builder.py:337-373)."""
    if seqlength is not None:
        if xdata.ndim != 3:
            raise RuntimeError(
                "A sequence_lengths array only makes sense for 3d "
                "(sequence) input; 2d fixed-vector data takes None.")
        if not isinstance(seqlength, np.ndarray) or seqlength.ndim != 1:
            raise RuntimeError(
                "sequence_lengths, when supplied, is a 1d numpy array "
                "(one entry per datapoint).")
        if seqlength.shape[0] != ydata.shape[0]:
            raise RuntimeError(
                f"Got {seqlength.shape[0]} sequence lengths for "
                f"{ydata.shape[0]} datapoints; the counts must agree.")
        if not np.issubdtype(seqlength.dtype, np.integer):
            raise RuntimeError(
                "sequence_lengths needs an integer dtype; got "
                f"{seqlength.dtype}.")
        if seqlength.min() <= 0 or seqlength.max() > xdata.shape[1]:
            raise RuntimeError(
                "Each sequence length must lie in [1, X.shape[1]] -- at "
                "least one element and no more than the padded axis "
                "holds.")
    elif xdata.ndim == 3:
        raise RuntimeError(
            "3d input (sequences, time series, graphs) needs a "
            "sequence_lengths array — one entry per row; got None.")


def _check_classes(ydata):
    if not np.issubdtype(ydata.dtype, np.integer):
        raise RuntimeError("For classification, y values must be "
                           "integers in [0, n_classes).")
    max_class, min_class = int(ydata.max()), int(ydata.min())
    if max_class == 0 or min_class != 0:
        raise RuntimeError("For classification, y must contain class 0 and "
                           "at least one other class.")
    return max_class


def _build_online_dataset(xdata, ydata, sequence_lengths=None,
                          chunk_size=2000, normalize_y=True,
                          task_type="regression"):
    _check_basic_array(xdata, ydata)
    _check_sequence_lengths(sequence_lengths, xdata, ydata)

    if task_type == "classification":
        max_class = _check_classes(ydata)
        return OnlineDataset(xdata, ydata, sequence_lengths, chunk_size,
                             0., 1., max_class)

    if normalize_y:
        trainy_mean = float(ydata.mean())
        trainy_std = float(ydata.std())
        if trainy_std == 0:
            raise RuntimeError("The y-values supplied are all identical.")
    else:
        trainy_mean, trainy_std = 0., 1.
    return OnlineDataset(xdata, ydata, sequence_lengths, chunk_size,
                         trainy_mean, trainy_std, None)


def build_online_dataset(xdata, ydata, sequence_lengths=None,
                         chunk_size=2000, normalize_y=True,
                         task_type="regression"):
    """Validated constructor for an in-memory dataset — the reference's
    module-level entry point of the same name and signature
    (dataset_builder.py:123-190), for drop-in migration.  New code should
    prefer ``build_regression_dataset`` / ``build_classification_dataset``,
    which route in-memory and file-backed inputs uniformly."""
    return _build_online_dataset(xdata, ydata, sequence_lengths,
                                 chunk_size, normalize_y, task_type)


def npy_file_shape(npy_file):
    """Shape of a .npy array without loading it
    (dataset_builder.py:440-449)."""
    with open(npy_file, "rb") as f_handle:
        version = np.lib.format.read_magic(f_handle)
        np.lib.format._check_version(version)
        arr_shape, _, _ = np.lib.format._read_array_header(f_handle, version)
    return arr_shape


def _streaming_y_stats(yfiles):
    """Chan et al. streaming mean/std over y files
    (dataset_builder.py:408-437)."""
    ndpoints = 0
    mean, var = 0.0, 0.0
    for yfile in yfiles:
        y = np.load(yfile).astype(np.float64)
        ny = y.shape[0]
        w1 = ny / (ny + ndpoints)
        w2 = ndpoints / (ndpoints + ny)
        w3 = ny * ndpoints / (ny + ndpoints) ** 2
        ymean = y.mean()
        var = w1 * y.std() ** 2 + w2 * var + w3 * (ymean - mean) ** 2
        mean = w1 * ymean + w2 * mean
        ndpoints += ny
    return mean, float(np.sqrt(var))


def _validate_offline_file_contents(xf, lfile, dim1):
    """Load one offline x file (and its sequence-length file, if any) and
    reject non-finite or extreme values before they can reach a solver
    (parity: dataset_builder.py:264-307)."""
    x_data = np.load(xf)
    if x_data.shape[0] == 0:
        raise RuntimeError(f"{xf} contains zero datapoints.")
    if np.isnan(x_data).any():
        raise RuntimeError(f"{xf} contains NaN entries.")
    if np.max(x_data) > 1e15 or np.min(x_data) < -1e15:
        raise RuntimeError(
            f"{xf} contains magnitudes beyond 1e15 (inf or unscaled "
            "data); rescale before building a dataset.")
    if lfile is not None:
        lengths = np.load(lfile)
        if not np.issubdtype(lengths.dtype, np.integer):
            raise RuntimeError(f"{lfile} must hold integer lengths.")
        if lengths.min() <= 0 or lengths.max() > dim1:
            raise RuntimeError(
                f"{lfile} has lengths outside (0, {dim1}] for its "
                "x file.")


def build_offline_np_dataset(xfiles, yfiles, sequence_lengths=None,
                             chunk_size=2000, normalize_y=True,
                             task_type="regression",
                             skip_safety_checks=False):
    """Validated constructor for file-backed datasets
    (dataset_builder.py:192-333).

    Sequence files (3d) may differ in their sequence axis (``shape[1]``)
    file-to-file, so ragged corpora need no global zero-padding on disk
    (parity: dataset_builder.py:282-291, HISTORY v0.1.2.2); batches are
    padded transiently to the longest file at stream time.  Unless
    ``skip_safety_checks`` is set, each x file's CONTENTS are also
    validated (NaN / >1e15 / empty, dataset_builder.py:264-275) -- one
    extra read of the corpus at build time.
    """
    if not isinstance(xfiles, list) or not isinstance(yfiles, list):
        raise RuntimeError("xfiles and yfiles must be lists of filepaths.")
    if len(xfiles) != len(yfiles) or len(xfiles) == 0:
        raise RuntimeError("xfiles and yfiles must be non-empty lists of "
                           "the same length.")
    if sequence_lengths is not None and len(sequence_lengths) != len(xfiles):
        raise RuntimeError("sequence_lengths must match xfiles in length.")

    xshape0 = npy_file_shape(xfiles[0])
    ndim = len(xshape0)
    if ndim not in (2, 3):
        raise RuntimeError("x files must contain 2d or 3d arrays.")
    if sequence_lengths is None and ndim == 3:
        raise RuntimeError("sequence_lengths cannot be None for 3d input.")
    if sequence_lengths is not None and ndim == 2:
        raise RuntimeError("sequence_lengths must be None for 2d input.")

    ndatapoints, max_dim1 = 0, xshape0[1]
    for i, (xf, yf) in enumerate(zip(xfiles, yfiles)):
        xshape = npy_file_shape(xf)
        yshape = npy_file_shape(yf)
        # 2d files must agree exactly; 3d files may vary in the sequence
        # axis (shape[1]) but must share the channel dims.
        if len(xshape) != ndim or xshape[2:] != xshape0[2:] or \
                (ndim == 2 and xshape[1] != xshape0[1]):
            raise RuntimeError(f"File {xf} has inconsistent shape.")
        max_dim1 = max(max_dim1, xshape[1])
        if len(yshape) != 1 or yshape[0] != xshape[0]:
            raise RuntimeError(f"Files {xf}, {yf} have mismatched "
                               "datapoint counts.")
        if xshape[0] > chunk_size:
            raise RuntimeError(
                f"File {xf} has more datapoints than chunk_size; re-chunk "
                "your files or increase chunk_size.")
        lfile = None
        if sequence_lengths is not None:
            lfile = sequence_lengths[i]
            lshape = npy_file_shape(lfile)
            if len(lshape) != 1 or lshape[0] != xshape[0]:
                raise RuntimeError(
                    f"Sequence-length file {lfile} does not "
                    "match its x file.")
        if not skip_safety_checks:
            _validate_offline_file_contents(xf, lfile, xshape[1])
        ndatapoints += xshape[0]

    # xdim[1] is the LONGEST sequence axis across files; shorter files
    # are padded transiently when batches are streamed.
    xdim = (ndatapoints, max_dim1) + tuple(xshape0[2:]) if ndim == 3 \
        else (ndatapoints,) + tuple(xshape0[1:])

    if task_type == "classification":
        max_class, min_class = 0, 1
        for yf in yfiles:
            y = np.load(yf)
            if not np.issubdtype(y.dtype, np.integer):
                raise RuntimeError("Classification y files must contain "
                                   "integer classes.")
            max_class = max(max_class, int(y.max()))
            min_class = min(min_class, int(y.min()))
        if max_class == 0 or min_class != 0:
            raise RuntimeError("Classification data must contain class 0 "
                               "and at least one other class.")
        return OfflineDataset(xfiles, yfiles, sequence_lengths, xdim,
                              0., 1., max_class, chunk_size)

    if normalize_y:
        trainy_mean, trainy_std = _streaming_y_stats(yfiles)
        if trainy_std == 0:
            raise RuntimeError("The y-values supplied are all identical.")
    else:
        trainy_mean, trainy_std = 0., 1.
    return OfflineDataset(xfiles, yfiles, sequence_lengths, xdim,
                          trainy_mean, trainy_std, None, chunk_size)
