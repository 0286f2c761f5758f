"""Dataset objects: in-memory and file-backed chunk streams.

Copied from xgpr_tpu/data/dataset.py (pure numpy).  API parity with the
reference xGPR's data_handling layer: deterministic chunk iteration
(so CG matvecs are exactly reproducible pass to pass), y normalised on the
fly for regression, user-subclassable baseclass.

``padded_batches`` yields fixed-shape chunks (padded to chunk_size) plus a
row mask, so every consumer sees one shape per dataset.  Padded rows
carry sequence_length = L (full length) so conv scaling stays finite;
their features are zeroed via the mask before any reduction.
"""
import abc
import itertools
from abc import ABC

import numpy as np

# Monotonic per-process dataset ids: unlike id(), never reused after GC,
# so caches keyed on a dataset stay dead once the dataset is gone.
_DATASET_UIDS = itertools.count()


class DatasetBaseclass(ABC):
    """Common API for chunked datasets."""

    def __init__(self, xdim, chunk_size, trainy_mean=0., trainy_std=1.,
                 max_class=None):
        self._xdim = tuple(xdim)
        self._chunk_size = int(chunk_size)
        self._trainy_mean = float(trainy_mean)
        self._trainy_std = float(trainy_std)
        self._max_class = max_class
        self._pad_dim1 = None
        self._uid = next(_DATASET_UIDS)

    def get_uid(self):
        """Process-unique, never-recycled identity for caching."""
        return self._uid

    @abc.abstractmethod
    def get_chunked_data(self):
        """Yield (xchunk, ychunk, seq_lengths-or-None) numpy chunks."""

    @abc.abstractmethod
    def get_chunked_x_data(self):
        """Yield (xchunk, seq_lengths-or-None) numpy chunks."""

    # ------------------------------------------------------------------
    def get_ymean(self):
        return self._trainy_mean

    def get_ystd(self):
        return self._trainy_std

    def get_n_classes(self):
        if self._max_class is None:
            return None
        return self._max_class + 1

    def get_xdim(self):
        return self._xdim

    def set_sequence_pad(self, dim1):
        """Raise the sequence-axis length ``padded_batches`` pads to.

        Multi-host engines call this with the MAX dim1 over all hosts'
        local datasets so every host emits identically-shaped batches
        (ragged corpora split across hosts otherwise diverge: each
        host's local maximum differs).  Extra positions fall beyond every
        row's sequence_length, so masked conv features are unchanged."""
        if len(self._xdim) != 3:
            raise ValueError(
                "set_sequence_pad applies to 3d (sequence) datasets "
                f"only; this dataset's xdim is {self._xdim}.")
        dim1 = int(dim1)
        if dim1 < self._xdim[1]:
            raise ValueError(
                f"sequence pad {dim1} is below this dataset's own "
                f"maximum sequence axis {self._xdim[1]}.")
        self._pad_dim1 = dim1

    def padded_seq_len(self):
        """Sequence-axis length of every batch ``padded_batches`` yields
        (the dataset max, or the multi-host override if one is set)."""
        if len(self._xdim) != 3:
            return None
        return self._pad_dim1 if self._pad_dim1 is not None \
            else self._xdim[1]

    def get_padded_xdim(self):
        """``get_xdim`` with dim1 replaced by the effective pad target:
        the shape contract of ``padded_batches`` output."""
        if len(self._xdim) != 3:
            return self._xdim
        return (self._xdim[0], self.padded_seq_len()) + self._xdim[2:]

    def get_ndatapoints(self):
        return self._xdim[0]

    def get_n_batches(self):
        """Number of padded batches ``padded_batches`` will yield, from
        metadata only (no data pass).  One batch per chunk; subclasses
        whose generators chunk differently (custom sources) must
        override this to match, since multi-host streaming derives its
        collective step count from it."""
        return -(-self._xdim[0] // self._chunk_size)

    def get_chunk_size(self):
        return self._chunk_size

    def _normalize_y(self, ychunk):
        if self._max_class is not None:
            return ychunk
        y = ychunk.astype(np.float64)
        return (y - self._trainy_mean) / self._trainy_std

    # ------------------------------------------------------------------
    # fixed-shape batches plus a row mask
    def padded_batches(self, with_y=True):
        """Yield fixed-shape (x, y|None, seq_len|None, mask) numpy batches.

        Every batch has exactly chunk_size rows; trailing rows of the final
        batch are zero-filled and flagged by mask == 0.  Sequence chunks
        whose dim1 is shorter than the dataset-wide maximum (ragged
        offline corpora) are zero-padded along the sequence axis too --
        the extra windows fall beyond every row's sequence_length, so
        masked conv features are unchanged.
        """
        cs = self._chunk_size
        p1 = self.padded_seq_len()
        src = self.get_chunked_data() if with_y else (
            (x, None, l) for x, l in self.get_chunked_x_data())
        for xchunk, ychunk, lchunk in src:
            n = xchunk.shape[0]
            dim1_pad = p1 - xchunk.shape[1] if xchunk.ndim == 3 else 0
            if n == cs and dim1_pad == 0:
                mask = np.ones((cs,), dtype=np.float64)
                yield xchunk, ychunk, lchunk, mask
                continue
            xp = np.zeros((cs, p1) + xchunk.shape[2:],
                          dtype=xchunk.dtype) if xchunk.ndim == 3 else \
                np.zeros((cs,) + xchunk.shape[1:], dtype=xchunk.dtype)
            xp[:n, :xchunk.shape[1]] = xchunk
            mask = np.zeros((cs,), dtype=np.float64)
            mask[:n] = 1.0
            yp = None
            if ychunk is not None:
                yp = np.zeros((cs,), dtype=ychunk.dtype)
                yp[:n] = ychunk
            lp = None
            if lchunk is not None:
                lp = np.full((cs,), p1, dtype=np.int32)
                lp[:n] = lchunk
            yield xp, yp, lp, mask


class OnlineDataset(DatasetBaseclass):
    """In-memory arrays served in chunk_size slices
    (online_data_handling.py:54-94)."""

    def __init__(self, xdata, ydata, sequence_lengths=None, chunk_size=2000,
                 trainy_mean=0., trainy_std=1., max_class=None):
        super().__init__(xdata.shape, chunk_size, trainy_mean, trainy_std,
                         max_class)
        self._xdata = xdata
        self._ydata = ydata
        self._sequence_lengths = sequence_lengths

    def get_chunked_data(self):
        for i in range(0, self._xdim[0], self._chunk_size):
            cut = min(i + self._chunk_size, self._xdim[0])
            lchunk = None if self._sequence_lengths is None else \
                self._sequence_lengths[i:cut]
            yield (self._xdata[i:cut, ...],
                   self._normalize_y(self._ydata[i:cut]), lchunk)

    def get_chunked_x_data(self):
        for i in range(0, self._xdim[0], self._chunk_size):
            cut = min(i + self._chunk_size, self._xdim[0])
            lchunk = None if self._sequence_lengths is None else \
                self._sequence_lengths[i:cut]
            yield self._xdata[i:cut, ...], lchunk


class OfflineDataset(DatasetBaseclass):
    """Out-of-core dataset: lists of .npy file paths, one load per chunk
    (offline_data_handling.py:73-108)."""

    def __init__(self, xfiles, yfiles, sequence_lengths, xdim,
                 trainy_mean=0., trainy_std=1., max_class=None,
                 chunk_size=2000):
        import os
        super().__init__(xdim, chunk_size, trainy_mean, trainy_std,
                         max_class)
        self._xfiles = [os.path.abspath(f) for f in xfiles]
        self._yfiles = [os.path.abspath(f) for f in yfiles]
        if sequence_lengths is not None:
            self._sequence_lengths = [os.path.abspath(f)
                                      for f in sequence_lengths]
        else:
            self._sequence_lengths = None

    def get_n_batches(self):
        # One chunk per file; files may be unevenly filled, so the
        # base class's ceil(N / chunk_size) does not apply.
        return len(self._xfiles)

    def _x_stream(self):
        """One np.load per chunk file.  (xgpr_tpu's native prefetching
        loader is not part of this package yet.)"""
        return (np.load(f) for f in self._xfiles)

    def get_chunked_data(self):
        lfiles = self._sequence_lengths or [None] * len(self._xfiles)
        for xchunk, yfile, lfile in zip(self._x_stream(), self._yfiles,
                                        lfiles):
            ychunk = self._normalize_y(np.load(yfile))
            lchunk = np.load(lfile) if lfile is not None else None
            yield xchunk, ychunk, lchunk

    def get_chunked_x_data(self):
        lfiles = self._sequence_lengths or [None] * len(self._xfiles)
        for xchunk, lfile in zip(self._x_stream(), lfiles):
            lchunk = np.load(lfile) if lfile is not None else None
            yield xchunk, lchunk
