"""The port's native npy streamer (xgpr_tpu_torch/native): chunks equal
np.load for every dtype and shape option, a bad file raises, a failed
build raises with the compiler's output, and six processes that build the
library at once into the same empty directory all load a complete one.

Every build here goes into a fresh temporary directory, so each is a
first build; the streaming tests share one."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from xgpr_tpu_torch.native import loader
from xgpr_tpu_torch.native import NativeNpyStream, native_available

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler on the PATH")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """One library build shared by the streaming tests."""
    path = str(tmp_path_factory.mktemp("lib"))
    assert native_available(path)
    return path


def _save(tmp_path, arrays):
    paths = []
    for i, a in enumerate(arrays):
        p = tmp_path / f"a{i}.npy"
        np.save(p, a)
        paths.append(str(p))
    return paths


def test_stream_matches_numpy(tmp_path, lib):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((37, 5)),
              rng.standard_normal((12, 5)).astype(np.float32),
              rng.integers(0, 100, size=(9, 5)).astype(np.int64),
              rng.integers(0, 100, size=(7, 5)).astype(np.int32),
              rng.standard_normal(11)]
    paths = _save(tmp_path, arrays)
    got = list(NativeNpyStream(paths, build_dir=lib))
    assert len(got) == len(arrays)
    for a, g, p in zip(arrays, got, paths):
        want = np.load(p)
        assert g.dtype == want.dtype and np.array_equal(g, want)


def test_stream_restores_row_shapes(tmp_path, lib):
    rng = np.random.default_rng(1)
    fixed = rng.standard_normal((8, 6, 4))
    ragged = [rng.standard_normal((5, n, 4)) for n in (3, 7)]
    got = list(NativeNpyStream(_save(tmp_path, [fixed]),
                               trailing_shape=(6, 4), build_dir=lib))
    assert np.array_equal(got[0], fixed)
    sub = tmp_path / "ragged"
    sub.mkdir()
    got = list(NativeNpyStream(_save(sub, ragged), inner_dim=4,
                               build_dir=lib))
    assert all(np.array_equal(g, a) for g, a in zip(got, ragged))


def test_stream_bad_file_raises(tmp_path, lib):
    p = tmp_path / "bad.npy"
    p.write_bytes(b"not an npy file at all")
    with pytest.raises(RuntimeError):
        list(NativeNpyStream([str(p)], build_dir=lib))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "_SRC", str(bad))
    with pytest.raises(RuntimeError, match="error"):
        loader.load_library(str(tmp_path / "lib"))
    assert not any((tmp_path / "lib").iterdir())


_CHILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("loader", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
import numpy as np
got = list(mod.NativeNpyStream([sys.argv[3]], build_dir=sys.argv[2]))
assert np.array_equal(got[0], np.load(sys.argv[3]))
print("ok")
"""


def test_concurrent_first_builds_all_succeed(tmp_path):
    """Six processes start on an empty build directory at once: each
    compiles into a file of its own and renames it into place, so none
    loads a half-written library."""
    path = _save(tmp_path, [np.arange(30.0).reshape(6, 5)])[0]
    lib = str(tmp_path / "lib")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, loader.__file__, lib, path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err
    assert os.listdir(lib) == [loader._LIB_NAME]
