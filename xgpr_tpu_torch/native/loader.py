"""ctypes bindings for the native npy chunk streamer (port of
xgpr_tpu/native/loader.py, with its own copy of ``npy_stream.cpp``).

The shared library is built on first use with g++ into ``build/`` beside
this file (git-ignored), or into the directory a caller passes.  Each
process compiles into a temporary file of its own in that directory and
moves it into place with ``os.replace``, so processes that build at the
same time never load a half-written library: whichever rename lands last
wins, and every loader opens a complete file.  A failed build raises
with g++'s output.  ``native_available()`` is False only when there is
neither a built library nor a g++ on the PATH.

    from xgpr_tpu_torch.native import NativeNpyStream
    for chunk in NativeNpyStream(["x0.npy", "x1.npy"]):
        ...                                  # numpy arrays, file by file
"""
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "npy_stream.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
_LIB_NAME = "_libxgpr_torch_io.so"

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}

_libs = {}
_lock = threading.Lock()


def _build(lib_path):
    """Compile the streamer into a temporary file beside ``lib_path`` and
    rename it into place."""
    build_dir = os.path.dirname(lib_path)
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=_LIB_NAME + ".", suffix=".tmp",
                               dir=build_dir)
    os.close(fd)
    try:
        out = subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
             _SRC, "-o", tmp], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError("Building the native npy streamer failed:\n"
                               + out.stderr)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib):
    lib.xgpr_stream_open.restype = ctypes.c_void_p
    lib.xgpr_stream_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64]
    lib.xgpr_stream_next.restype = ctypes.c_int
    lib.xgpr_stream_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int)]
    lib.xgpr_stream_close.restype = None
    lib.xgpr_stream_close.argtypes = [ctypes.c_void_p]
    return lib


def load_library(build_dir=None):
    """The streamer's ctypes library, built into ``build_dir`` (default
    ``BUILD_DIR``) when missing or older than its source; raises if the
    build fails."""
    lib_path = os.path.join(build_dir or BUILD_DIR, _LIB_NAME)
    with _lock:
        lib = _libs.get(lib_path)
        if lib is None:
            if not os.path.exists(lib_path) or \
                    os.path.getmtime(lib_path) < os.path.getmtime(_SRC):
                _build(lib_path)
            lib = _libs[lib_path] = _bind(ctypes.CDLL(lib_path))
    return lib


def native_available(build_dir=None) -> bool:
    """Whether the streamer can be used: True once its library loads (a
    build is attempted, and raises if g++ fails); False only when no
    library is built and g++ is not on the PATH."""
    lib_path = os.path.join(build_dir or BUILD_DIR, _LIB_NAME)
    if not os.path.exists(lib_path) and shutil.which("g++") is None:
        return False
    load_library(build_dir)
    return True


class NativeNpyStream:
    """Iterate .npy files as numpy arrays with background prefetch.

    Shapes beyond the leading axis are flattened by the native layer; pass
    ``trailing_shape`` to restore a fixed per-row shape, or, for 3d files
    whose sequence axis varies from file to file, ``inner_dim`` (the fixed
    channel width): each chunk is then reshaped to (rows, cols //
    inner_dim, inner_dim).
    """

    def __init__(self, paths, trailing_shape=None, depth=2,
                 inner_dim=None, build_dir=None):
        lib = load_library(build_dir)
        self._lib = lib
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.xgpr_stream_open(arr, len(self._paths), depth)
        self._trailing = trailing_shape
        self._inner_dim = inner_dim
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        buf = ctypes.c_void_p()
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        code = ctypes.c_int()
        status = self._lib.xgpr_stream_next(
            self._handle, ctypes.byref(buf), ctypes.byref(rows),
            ctypes.byref(cols), ctypes.byref(code))
        if status == 0:
            self.close()
            raise StopIteration
        if status < 0:
            self.close()
            raise RuntimeError("Native npy stream failed (bad file?).")
        dtype = _DTYPES[code.value]
        n = rows.value * cols.value
        # Copy out of the stream-owned buffer (valid until the next call).
        src = (ctypes.c_char * (n * np.dtype(dtype).itemsize)).from_address(
            buf.value)
        out = np.frombuffer(bytes(src), dtype=dtype).reshape(
            rows.value, cols.value)
        if self._inner_dim is not None:
            out = out.reshape(rows.value, cols.value // self._inner_dim,
                              self._inner_dim)
        elif self._trailing is not None:
            out = out.reshape((rows.value,) + tuple(self._trailing))
        elif cols.value == 1:
            out = out.reshape(rows.value)
        return out

    def close(self):
        if not self._closed and self._handle:
            self._lib.xgpr_stream_close(self._handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
